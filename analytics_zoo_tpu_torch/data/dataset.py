"""Fixed-shape minibatches from host arrays, for the estimator.

The port's own trimmed copy of ``analytics_zoo_tpu/data/dataset.py``:
``ShardedDataset`` over numpy arrays (one array, a tuple or list of
arrays, or a dict of them, equal length on axis 0) and
``to_sharded_dataset`` for ndarrays, ``(x, y)`` pairs, ``{"x", "y"}``
dicts, XShards of ``{"x", "y"}`` dicts or of pandas DataFrames, and
DataFrames (with ``feature_cols`` / ``label_cols``). One process feeds one
device, so a global batch is a host batch.

``iter_batches`` cuts the batches in the JAX package's exact order: the
shuffle is ``np.random.default_rng((seed * 100003 + epoch) &
0x7FFFFFFF).shuffle`` of ``arange(n)``. Training drops the final partial
batch; evaluation and prediction pad it with row 0 and yield a float32
{0, 1} mask of its valid rows. The streaming (tiered) feed is not
ported yet (ROADMAP A5).
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.data.shard import HostXShards, XShards, _flatten


def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


def _tree_take(data, idx):
    return tree_map(lambda a: a[idx], data)


def _tree_len(data) -> int:
    return len(_tree_leaves(data)[0])


def _tree_concat(shards):
    parts = [_flatten(s) for s in shards]
    leaves = [np.concatenate([p[0][i] for p in parts])
              for i in range(len(parts[0][0]))]
    return parts[0][1](leaves)


def _shards_to_xy(data, feature_cols=None, label_cols=None):
    """A list of shards → one (x, y) pair. Shards are Orca-style
    ``{"x": ..., "y": ...}`` numpy dicts or pandas DataFrames (then
    feature/label column names select the columns; a column of arrays is
    stacked)."""
    first = data[0]
    if isinstance(first, dict) and "x" in first:
        x = _tree_concat([d["x"] for d in data])
        y = _tree_concat([d["y"] for d in data]) \
            if first.get("y") is not None else None
        return x, y
    import pandas as pd
    if not isinstance(first, pd.DataFrame):
        raise TypeError(f"unsupported shard type {type(first).__name__}")
    if not feature_cols:
        raise ValueError("feature_cols required for DataFrame shards")
    big = pd.concat(data, ignore_index=True)

    def cols_to_tree(cols):
        if isinstance(cols, str):
            cols = [cols]
        arrs = [np.asarray(np.stack(big[c].to_numpy())
                           if big[c].dtype == object else big[c].to_numpy())
                for c in cols]
        return arrs[0] if len(arrs) == 1 else tuple(arrs)

    x = cols_to_tree(feature_cols)
    y = cols_to_tree(label_cols) if label_cols else None
    return x, y


class ShardedDataset:
    """Host-resident columnar dataset with deterministic batching. ``x`` and
    ``y`` are numpy arrays or tuples, lists or dicts of them; ``y`` may be
    None (predict)."""

    def __init__(self, x, y=None):
        self.x = tree_map(np.asarray, x)
        self.y = None if y is None else tree_map(np.asarray, y)
        self.n = _tree_len(self.x)
        if any(len(a) != self.n for a in _tree_leaves(self.x)):
            raise ValueError("inputs differ in length")
        if self.y is not None and _tree_len(self.y) != self.n:
            raise ValueError("x/y length mismatch")

    @classmethod
    def from_xshards(cls, shards: XShards, feature_cols=None,
                     label_cols=None) -> "ShardedDataset":
        """From XShards of ``{"x", "y"}`` numpy dicts (the Orca
        convention) or of pandas DataFrames with feature/label column
        names (ref orca/learn/tf/estimator.py:373-426 to_dataset)."""
        data = shards.collect()
        if not data:
            raise ValueError("empty XShards")
        return cls(*_shards_to_xy(data, feature_cols, label_cols))

    def iter_batches(self, batch_size: int, shuffle: bool = False,
                     seed: int = 0, epoch: int = 0,
                     drop_remainder: bool = True
                     ) -> Iterator[Tuple[Any, Any, Optional[np.ndarray]]]:
        """Yield (x, y, mask) numpy batches of fixed shape. mask is None for
        full batches; for a padded final batch it is a float32 {0, 1}
        vector of valid rows."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if batch_size > self.n and drop_remainder:
            raise ValueError(f"batch_size {batch_size} > dataset size "
                             f"{self.n} (with drop_remainder=True no batch "
                             "can be formed)")
        order = np.arange(self.n)
        if shuffle:
            rng = np.random.default_rng((seed * 100003 + epoch) & 0x7FFFFFFF)
            rng.shuffle(order)
        full = self.n // batch_size
        for b in range(full):
            idx = order[b * batch_size:(b + 1) * batch_size]
            yield (_tree_take(self.x, idx),
                   None if self.y is None else _tree_take(self.y, idx),
                   None)
        rem = self.n - full * batch_size
        if rem and not drop_remainder:
            idx = order[full * batch_size:]
            pad = np.concatenate([idx, np.zeros(batch_size - rem,
                                                dtype=idx.dtype)])
            mask = np.zeros(batch_size, np.float32)
            mask[:rem] = 1.0
            yield (_tree_take(self.x, pad),
                   None if self.y is None else _tree_take(self.y, pad),
                   mask)


def _is_dataframe(data) -> bool:
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover
        return False
    return isinstance(data, pd.DataFrame)


def to_sharded_dataset(data, feature_cols=None, label_cols=None
                       ) -> ShardedDataset:
    """The estimator's accepted inputs as a ShardedDataset: a
    ShardedDataset, XShards or a pandas DataFrame (with ``feature_cols``
    and ``label_cols`` for DataFrames), an ``(x, y)`` pair, an
    ``{"x": ..., "y": ...}`` dict, or features alone (an array, or a dict
    without ``"x"``)."""
    if isinstance(data, ShardedDataset):
        return data
    if isinstance(data, XShards):
        return ShardedDataset.from_xshards(data, feature_cols, label_cols)
    if _is_dataframe(data):
        return ShardedDataset.from_xshards(HostXShards([data]), feature_cols,
                                           label_cols)
    if isinstance(data, tuple) and len(data) == 2:
        return ShardedDataset(data[0], data[1])
    if isinstance(data, dict) and "x" in data:
        return ShardedDataset(data["x"], data.get("y"))
    if isinstance(data, (np.ndarray, dict, tuple, list)):
        return ShardedDataset(data)
    raise TypeError(f"cannot feed {type(data).__name__} to the estimator: "
                    "pass ndarrays, an (x, y) pair, an {'x', 'y'} dict, "
                    "XShards or a DataFrame")
