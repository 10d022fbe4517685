"""The port's kernels on a rank's shard: the tensor-parallel paths.

Under a strategy the estimator (learn/estimator.py) keeps each sharded
parameter as this rank's block (``convert.TorchShard``, reachable from
the parameter as ``shard_of(param)``). A module that can compute on the
block says so with ``sharded_params(shards)``: given the shards of its
subtree (names relative to it), it returns the names it computes on as
blocks; every other sharded parameter is all-gathered for its product,
the FSDP way. The paths:

- a table sharded by columns (``(None, "model")``): the lookup kernel
  (B1) runs on the rank's ``[rows, d / p]`` block, a tensor of its own,
  and the features are all-gathered along the last dim; the gradient goes
  through the scatter kernel (B1b) on the block (``lookup_columns``).
- a Dense sharded by output features (flax ``(None, "model")``): the
  product on the rank's rows of the weight, the output all-gathered
  (``column_linear``).
- Megatron's pairs (BERT's attention and FFN under ``bert_tp_rules``):
  the column-parallel half keeps its output sharded (the attention on
  ``h / p`` heads), the row-parallel half sums its partial products with
  one ``all_reduce`` and adds its bias after (``row_linear``).

Only a block over an axis whose ranks hold the same rows is computed on:
a block over ``data`` or ``fsdp`` is always gathered. A parameter marked
with its shard is always a block the estimator let a module compute on
(the others reach the forward whole), so a module tells its path by the
mark alone.

A replicated bias of a column-parallel product is cut to the rank's
block (``block``): its gradient lands in that block, and the gradients'
reduction over the replicated axes sums the blocks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.parallel import collectives
from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib


def shard_of(t) -> Optional[object]:
    """The ``TorchShard`` a parameter is the block of, or None."""
    return getattr(t, "_zoo_shard", None)


#: axes whose ranks hold different rows: a block over one of them is
#: never computed on (its ranks' products would mix rows), only gathered
_ROW_AXES = frozenset({mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS})


def split_axis(shard, dim: int) -> Optional[str]:
    """The one mesh axis ``shard`` cuts torch dim ``dim`` into contiguous
    blocks over, or None (also for an axis of the batch)."""
    if shard is None or shard.torch_dim != dim:
        return None
    (axes,) = shard.dims.values()
    if len(axes) != 1 or axes[0] in _ROW_AXES:
        return None
    return axes[0]


def covers(shards: Dict[str, object], names: Sequence[str], dim: int,
           axis: Optional[str] = None) -> Optional[str]:
    """The one axis every parameter in ``names`` is split over along
    ``dim`` (``axis`` if given), or None when any is not."""
    found = axis
    for n in names:
        ax = split_axis(shards.get(n), dim)
        if ax is None or (found is not None and ax != found):
            return None
        found = ax
    return found


def block(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous block of a replicated tensor along
    ``dim``."""
    p = mesh.shape[axis]
    step = t.shape[dim] // p
    return t.narrow(dim, mesh.coord(axis) * step, step)


def local_bias(bias, weight_shard, mesh, axis: str):
    """The bias of a column-parallel product on this rank: the block
    itself where the bias is sharded alike, else its block."""
    if bias is None:
        return None
    if split_axis(shard_of(bias), 0) == axis:
        return bias
    return block(bias, mesh, axis, 0)


def column_linear(x, weight, bias, dtype, gather: bool = True):
    """``x @ W.T + b`` with ``W`` split by output rows: the rank's output
    columns, all-gathered along the last dim when ``gather``."""
    from analytics_zoo_tpu_torch.common.flax_compat import promote
    shard = shard_of(weight)
    axis = split_axis(shard, 0)
    b = local_bias(bias, shard, shard.mesh, axis)
    cd = promote(dtype, x, weight)
    y = F.linear(x.to(cd), weight.to(cd), None if b is None else b.to(cd))
    return collectives.all_gather(y, shard.mesh, axis, -1) if gather else y


def row_linear(x_local, weight, bias, dtype):
    """``x @ W.T + b`` with ``W`` split by input columns and ``x`` by its
    last dim alike: the partial products summed over the axis, then the
    (replicated) bias."""
    from analytics_zoo_tpu_torch.common.flax_compat import promote
    shard = shard_of(weight)
    axis = split_axis(shard, 1)
    cd = promote(dtype, x_local, weight)
    y = collectives.all_reduce(F.linear(x_local.to(cd), weight.to(cd)),
                               shard.mesh, axis)
    return y if bias is None else y + bias.to(cd)


def lookup_columns(tables, lookup, widths=None):
    """``lookup(tables)`` on column-split tables, then the features
    gathered: ``widths`` (the local width each table contributes side by
    side, a concat) are put back table by table; without, the output's
    columns are the tables' columns (one table, or an elementwise
    combine)."""
    shard = shard_of(tables[0])
    axis = split_axis(shard, 1)
    out = collectives.all_gather(lookup(tables), shard.mesh, axis, -1)
    if widths is None or len(widths) == 1:
        return out
    p = shard.mesh.shape[axis]
    blocks = out.unflatten(-1, (p, sum(widths))).split(list(widths), -1)
    return torch.cat([b.flatten(-2) for b in blocks], -1)


def table_covered(shards: Dict[str, object]) -> set:
    """``sharded_params`` of a module owning one ``embedding`` table:
    the table where it is split by columns over one axis."""
    return {"embedding"} if covers(shards, ["embedding"], 1) else set()
