"""XShards — a partitioned collection of host objects.

The port's own trimmed copy of ``analytics_zoo_tpu/data/shard.py`` (ref
pyzoo/zoo/orca/data/shard.py:25-470): ``XShards`` and ``HostXShards``
with ``partition``, ``from_records``, ``transform_shard``, ``collect`` and
``num_partitions``. Shards are numpy-dict shards, pandas DataFrames or any
Python objects, held in this process. One process feeds one device, so
the default number of shards is 1 (the JAX package takes its context's
device count). Memory tiers (``DISK_n``), the
thread-pool transforms and the rest of the reference's methods
(``first``, ``len``, ``repartition``, ``partition_by``, ``split``,
``zip``, pickling) are not ported (ROADMAP A5).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np


def _flatten(tree) -> Tuple[list, Callable[[list], Any]]:
    """(leaves of nested dicts, tuples and lists, a function that rebuilds
    the tree from new leaves)."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new):
        out, at = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(new[at:at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


class XShards:
    """Abstract base (ref shard.py:25-70)."""

    def transform_shard(self, func: Callable, *args) -> "XShards":
        raise NotImplementedError

    def collect(self) -> List[Any]:
        raise NotImplementedError

    def num_partitions(self) -> int:
        raise NotImplementedError

    @staticmethod
    def from_records(records, num_shards: Optional[int] = None
                     ) -> "HostXShards":
        """Partition a flat list of opaque records (feature objects, rows)
        into contiguous shards without descending into them."""
        n = num_shards or 1
        n = max(1, min(n, len(records))) if records else 1
        splits = np.array_split(np.arange(len(records)), n)
        return HostXShards([[records[i] for i in idx] for idx in splits])

    @staticmethod
    def partition(data, num_shards: Optional[int] = None) -> "HostXShards":
        """Partition an ndarray, or a dict / (nested) list or tuple of
        them, into shards along axis 0 (ref shard.py:73-127)."""
        n = num_shards or 1
        leaves, rebuild = _flatten(data)
        if not leaves:
            raise ValueError("empty data")
        lengths = {len(a) for a in leaves}
        if len(lengths) != 1:
            raise ValueError(f"all arrays must share axis-0 length, got "
                             f"{lengths}")
        total = lengths.pop()
        if total < n:
            raise ValueError(f"cannot split {total} rows into {n} shards")
        return HostXShards([rebuild([np.asarray(a)[idx] for a in leaves])
                            for idx in np.array_split(np.arange(total), n)])


class HostXShards(XShards):
    """Shards resident in this host process (ref SparkXShards,
    shard.py:129)."""

    def __init__(self, shards: Iterable[Any]):
        self._shards = list(shards)

    def transform_shard(self, func: Callable, *args) -> "HostXShards":
        """``func(shard, *args)`` on every shard, in order."""
        return HostXShards(func(s, *args) for s in self._shards)

    def collect(self) -> List[Any]:
        return list(self._shards)

    def num_partitions(self) -> int:
        return len(self._shards)
