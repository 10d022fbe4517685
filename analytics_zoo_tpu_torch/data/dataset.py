"""Fixed-shape minibatches from host arrays, for the estimator.

The port's own copy of ``analytics_zoo_tpu/data/dataset.py``:

- ``ShardedDataset`` over numpy arrays (one array, a tuple or list of
  arrays, or a dict of them, equal length on axis 0), with
  ``from_ndarrays``, ``from_xshards``, ``map``, ``take``, ``split`` and
  ``steps_per_epoch``. ``iter_batches`` cuts the batches in the JAX
  package's exact order: the shuffle is ``np.random.default_rng((seed *
  100003 + epoch) & 0x7FFFFFFF).shuffle`` of ``arange(n)``. Training drops
  the final partial batch; evaluation and prediction pad it with row 0
  and yield a float32 {0, 1} mask of its valid rows.
- ``StreamingShardedDataset``: the out-of-core feed over a tiered shard
  store (ref DiskFeatureSet, FeatureSet.scala:556), JAX's window plan bit
  for bit: windows of ``ceil(shards / n)`` shards for a "DISK_n" store;
  with the same seed the shard order and then each window's rows are
  permuted by one generator; rows left over carry into the next window so
  every batch is full; the tail is padded and masked as above. Windows
  load on the data pool (``data/shard.py``) up to ``prefetch_depth``
  ahead (``ZOO_DATA_PREFETCH``, default 1). ``peak_window_rows`` records
  the most rows one window held with its carry. Its ``x`` and ``y`` are
  None: rows never gather on the dataset. ``OP_TOTALS["stream_window"]``
  counts the windows' load time.
- ``to_sharded_dataset`` for ndarrays, ``(x, y)`` pairs, ``{"x", "y"}``
  dicts, XShards of ``{"x", "y"}`` dicts or of pandas DataFrames (a tier
  other than DRAM streams), and DataFrames (with ``feature_cols`` /
  ``label_cols``).

One process feeds one device (a rank, ``parallel/mesh.py``). With
``process_fraction`` (JAX's per-host feed) ``iter_batches`` cuts each
rank's batches of ``batch_size * process_fraction`` rows from the rank's
own data: across ranks a global batch is the ranks' blocks in data-index
order (``ShardingStrategy.batch_feed_fraction``: ``1 / n`` where the
batch axes make ``n`` blocks, 1.0 where the batch is replicated).
``device_iterator(mesh, strategy, batch_size, ...)`` yields those
batches on the rank's device, and ``device_scan_iterator`` stacks
``steps_per_loop`` of them into one copy for the estimator's
``fit(steps_per_loop=k)`` (its one-device form of earlier slices,
``(device, batch_size, steps_per_loop, ...)``, stays). No module here
imports pandas at import time; a DataFrame shard is told apart without
importing it.
"""

from __future__ import annotations

import itertools
import math
import os
import time
from collections import deque
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common import telemetry
from analytics_zoo_tpu_torch.data import shard as shard_lib
from analytics_zoo_tpu_torch.data.shard import (HostXShards, XShards,
                                                _flatten, _is_dataframe)


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


def _stack_tree(trees, put):
    """Leaf-wise ``np.stack`` of same-shaped trees, each stacked leaf
    passed through ``put``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_tree([t[k] for t in trees], put) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_tree([t[i] for t in trees], put)
                           for i in range(len(first)))
    return put(np.stack(trees))


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
    if not _is_dataframe(first):
        raise TypeError(f"unsupported shard type {type(first).__name__}")
    if not feature_cols:
        raise ValueError("feature_cols required for DataFrame shards")
    import pandas as pd
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


def _check_batch(batch_size: int, n: int, drop_remainder: bool) -> None:
    if batch_size < 1:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    if batch_size > n and drop_remainder:
        raise ValueError(f"batch_size {batch_size} > dataset size {n} (with "
                         "drop_remainder=True no batch can be formed)")


def _padded_tail(x, y, idx, batch_size: int):
    """The last partial batch of rows ``idx``, padded with row 0 of
    ``idx``'s source, and its mask."""
    rem = len(idx)
    pad = np.concatenate([idx, np.zeros(batch_size - rem, dtype=idx.dtype)])
    mask = np.zeros(batch_size, np.float32)
    mask[:rem] = 1.0
    return (_tree_take(x, pad),
            None if y is None else _tree_take(y, pad), mask)


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

    # ---- constructors ----
    @classmethod
    def from_ndarrays(cls, x, y=None) -> "ShardedDataset":
        return cls(x, y)

    @classmethod
    def from_xshards(cls, shards: XShards, feature_cols=None,
                     label_cols=None) -> "ShardedDataset":
        """From XShards of ``{"x", "y"}`` numpy dicts (the Orca
        convention) or of pandas DataFrames with feature/label column
        names (ref orca/learn/tf/estimator.py:373-426 to_dataset). Gathers
        every shard: ``StreamingShardedDataset`` keeps a tier's bound."""
        data = shards.collect()
        if not data:
            raise ValueError("empty XShards")
        return cls(*_shards_to_xy(data, feature_cols, label_cols))

    # ---- transforms ----
    def map(self, fn: Callable) -> "ShardedDataset":
        """``fn(x, y) -> (x, y)`` over the whole dataset."""
        x, y = fn(self.x, self.y)
        return ShardedDataset(x, y)

    def take(self, n: int) -> "ShardedDataset":
        """The first ``n`` rows."""
        idx = np.arange(min(n, self.n))
        return ShardedDataset(_tree_take(self.x, idx),
                              None if self.y is None
                              else _tree_take(self.y, idx))

    def split(self, fraction: float, seed: int = 0):
        """A random (``fraction``, rest) split, JAX's permutation."""
        perm = np.random.default_rng(seed).permutation(self.n)
        k = int(self.n * fraction)

        def part(idx):
            return ShardedDataset(_tree_take(self.x, idx),
                                  None if self.y is None
                                  else _tree_take(self.y, idx))
        return part(perm[:k]), part(perm[k:])

    # ---- batching ----
    def steps_per_epoch(self, batch_size: int,
                        drop_remainder: bool = True) -> int:
        if drop_remainder:
            return self.n // batch_size
        return math.ceil(self.n / batch_size)

    @staticmethod
    def _per_host(batch_size: int, process_fraction: Optional[float]) -> int:
        """This rank's rows of each global batch: all of them without a
        fraction (one rank), else ``batch_size * process_fraction``, which
        must be a whole number."""
        if process_fraction is None:
            return batch_size
        per_host = int(round(batch_size * process_fraction))
        if abs(per_host - batch_size * process_fraction) > 1e-9 or \
                per_host < 1:
            raise ValueError(
                f"global batch {batch_size} does not divide over the "
                f"process feed fraction {process_fraction}")
        return per_host

    def iter_batches(self, batch_size: int, shuffle: bool = False,
                     seed: int = 0, epoch: int = 0,
                     drop_remainder: bool = True,
                     process_fraction: Optional[float] = None
                     ) -> Iterator[Tuple[Any, Any, Optional[np.ndarray]]]:
        """Yield (x, y, mask) numpy batches of fixed shape (``batch_size *
        process_fraction`` rows of this rank's data with a fraction). mask
        is None for full batches; for a padded final batch it is a float32
        {0, 1} vector of valid rows."""
        batch_size = self._per_host(batch_size, process_fraction)
        _check_batch(batch_size, self.n, drop_remainder)
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
        if self.n > full * batch_size and not drop_remainder:
            yield _padded_tail(self.x, self.y, order[full * batch_size:],
                               batch_size)

    def device_iterator(self, mesh, strategy, batch_size: int,
                        shuffle: bool = False, seed: int = 0,
                        epoch: int = 0, drop_remainder: bool = True):
        """(JAX ``device_iterator``) ``iter_batches`` with the strategy's
        feed fraction on ``mesh``, each batch (x, y and mask) as tensors
        on this rank's device: its block of the global batch."""
        from analytics_zoo_tpu_torch.common.device import as_tensor
        _check_divisible(mesh, strategy, batch_size)
        device = mesh.device
        for x, y, mask in self.iter_batches(
                batch_size, shuffle, seed, epoch, drop_remainder,
                process_fraction=strategy.batch_feed_fraction(mesh)):
            put = lambda t: None if t is None else tree_map(  # noqa: E731
                lambda a: as_tensor(a, device), t)
            yield put(x), put(y), put(mask)

    def device_scan_iterator(self, mesh, strategy, batch_size=None,
                             steps_per_loop=None, shuffle: bool = False,
                             seed: int = 0, epoch: int = 0, skip: int = 0):
        """(JAX ``device_scan_iterator(mesh, strategy, batch_size,
        steps_per_loop, ...)``) ``steps_per_loop`` full batches of this
        rank's feed, in ``iter_batches``' order, stacked into one ``[k,
        batch, ...]`` copy to the rank's device: yields ``(x_stack,
        y_stack, k)`` with torch tensors (``y_stack`` None without
        labels). The tail group may have ``k < steps_per_loop``; rows that
        fill no batch are dropped. The first ``skip`` batches are left out
        (a resume inside the epoch). A ``StreamingShardedDataset`` groups
        the batches of its own feed. Given a ``torch.device`` first, the
        one-device form: ``(device, batch_size, steps_per_loop, shuffle,
        ...)``."""
        from analytics_zoo_tpu_torch.common.device import as_tensor
        from analytics_zoo_tpu_torch.parallel.mesh import DeviceMesh
        if isinstance(mesh, DeviceMesh):
            device = mesh.device
            _check_divisible(mesh, strategy, batch_size)
            fraction = strategy.batch_feed_fraction(mesh) \
                if mesh.size > 1 else None
        else:
            # (device, batch_size, steps_per_loop[, shuffle])
            device, fraction = mesh, None
            if steps_per_loop is not None:
                shuffle = steps_per_loop
            batch_size, steps_per_loop = strategy, batch_size

        def place(group):
            xs, ys = zip(*group)
            x = _stack_tree(xs, lambda a: as_tensor(a, device))
            y = None if ys[0] is None else \
                _stack_tree(ys, lambda a: as_tensor(a, device))
            return x, y, len(group)

        group = []
        batches = self.iter_batches(batch_size, shuffle, seed, epoch,
                                    drop_remainder=True,
                                    process_fraction=fraction)
        for x, y, _ in itertools.islice(batches, skip, None):
            group.append((x, y))
            if len(group) == steps_per_loop:
                yield place(group)
                group = []
        if group:
            yield place(group)


def _check_divisible(mesh, strategy, batch_size: int) -> None:
    """The global batch divides over the mesh's batch axes (ref
    tf_dataset.py:117)."""
    divisor = strategy.batch_shards(mesh)
    if batch_size % divisor:
        raise ValueError(
            f"batch_size {batch_size} must be divisible by the mesh "
            f"batch-axis size {divisor} (axes {strategy.batch_axes()})")


def _prefetch_default() -> int:
    raw = os.environ.get("ZOO_DATA_PREFETCH", "").strip()
    return int(raw) if raw.isdigit() else 1


class StreamingShardedDataset(ShardedDataset):
    """Out-of-core minibatch feed over a tiered shard store (the module
    docstring has the plan). Peak host residency is about one window plus
    one carry plus ``prefetch_depth`` loading windows, never the whole
    dataset."""

    def __init__(self, shards: HostXShards, feature_cols=None,
                 label_cols=None, window_shards: Optional[int] = None,
                 prefetch_depth: Optional[int] = None):
        self._xshards = shards
        self._fc, self._lc = feature_cols, label_cols
        # one pass for each shard's row count: DataFrame and {"x", "y"}
        # shards report their length without converting a column
        self._lens = []
        for s in shards._iter_shards():
            if _is_dataframe(s):
                self._lens.append(len(s))
            elif isinstance(s, dict) and "x" in s:
                self._lens.append(_tree_len(s["x"]))
            else:
                x, _ = _shards_to_xy([s], feature_cols, label_cols)
                self._lens.append(_tree_len(x))
        self.n = sum(self._lens)
        if prefetch_depth is None:
            prefetch_depth = _prefetch_default()
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.x = None
        self.y = None
        if window_shards is None:
            tier = getattr(shards, "tier", "DRAM")
            denom = max(1, int(tier.split("_", 1)[1])) if "_" in tier else 1
            window_shards = max(1, math.ceil(shards.num_partitions() / denom))
        self.window_shards = int(window_shards)
        self.peak_window_rows = 0

    def prefetch(self, depth: int) -> "StreamingShardedDataset":
        """Set how many windows load ahead of the device (fluent)."""
        self.prefetch_depth = max(1, int(depth))
        return self

    # whole-dataset transforms gather every shard
    def _materialize(self) -> ShardedDataset:
        x, y = _shards_to_xy(self._xshards.collect(), self._fc, self._lc)
        return ShardedDataset(x, y)

    def map(self, fn: Callable) -> ShardedDataset:
        return self._materialize().map(fn)

    def take(self, n: int) -> ShardedDataset:
        return self._materialize().take(n)

    def split(self, fraction: float, seed: int = 0):
        return self._materialize().split(fraction, seed)

    def iter_batches(self, batch_size: int, shuffle: bool = False,
                     seed: int = 0, epoch: int = 0,
                     drop_remainder: bool = True,
                     process_fraction: Optional[float] = None
                     ) -> Iterator[Tuple[Any, Any, Optional[np.ndarray]]]:
        batch_size = self._per_host(batch_size, process_fraction)
        _check_batch(batch_size, self.n, drop_remainder)
        n_shards = self._xshards.num_partitions()
        rng = np.random.default_rng((seed * 100003 + epoch) & 0x7FFFFFFF)
        shard_order = rng.permutation(n_shards) if shuffle \
            else np.arange(n_shards)
        windows = [shard_order[i:i + self.window_shards]
                   for i in range(0, n_shards, self.window_shards)]
        store = self._xshards._store

        def load_window(ids):
            t0 = time.perf_counter()
            out = _shards_to_xy([store.get(int(i)) for i in ids],
                                self._fc, self._lc)
            shard_lib.record_op("stream_window", time.perf_counter() - t0)
            return out

        # window assembly runs on the shared data pool, up to
        # prefetch_depth windows ahead of the device
        depth = self.prefetch_depth
        telemetry.get_registry().gauge(
            "zoo_data_prefetch_depth",
            "streaming-feed windows loading ahead of the device").set(depth)
        pool = shard_lib.get_data_pool()
        pending: deque = deque()
        nxt = 0

        def top_up():
            nonlocal nxt
            while nxt < len(windows) and len(pending) < depth:
                pending.append(pool.submit(load_window, windows[nxt]))
                nxt += 1

        top_up()
        carry_x = carry_y = None
        for _ in range(len(windows)):
            x, y = pending.popleft().result()
            top_up()
            if carry_x is not None:
                x = _tree_concat([carry_x, x])
                y = _tree_concat([carry_y, y]) if y is not None else None
            rows = _tree_len(x)
            self.peak_window_rows = max(self.peak_window_rows, rows)
            order = rng.permutation(rows) if shuffle else np.arange(rows)
            full = rows // batch_size
            for b in range(full):
                idx = order[b * batch_size:(b + 1) * batch_size]
                yield (_tree_take(x, idx),
                       None if y is None else _tree_take(y, idx), None)
            if rows > full * batch_size:
                idx = order[full * batch_size:]
                carry_x = _tree_take(x, idx)
                carry_y = None if y is None else _tree_take(y, idx)
            else:
                carry_x = carry_y = None
        if carry_x is not None and not drop_remainder:
            yield _padded_tail(carry_x, carry_y,
                               np.arange(_tree_len(carry_x)), batch_size)


def to_sharded_dataset(data, feature_cols=None, label_cols=None
                       ) -> ShardedDataset:
    """The estimator's accepted inputs as a ShardedDataset: a
    ShardedDataset, XShards (a tier other than DRAM streams, keeping the
    store's bound) or a pandas DataFrame (with ``feature_cols`` and
    ``label_cols`` for DataFrames), an ``(x, y)`` pair, an
    ``{"x": ..., "y": ...}`` dict, or features alone (an array, or a dict
    without ``"x"``)."""
    if isinstance(data, ShardedDataset):
        return data
    if isinstance(data, XShards):
        if getattr(data, "tier", "DRAM") != "DRAM":
            return StreamingShardedDataset(data, feature_cols, label_cols)
        return ShardedDataset.from_xshards(data, feature_cols, label_cols)
    if _is_dataframe(data):
        return ShardedDataset.from_xshards(HostXShards([data],
                                                       transient=True),
                                           feature_cols, label_cols)
    if isinstance(data, tuple) and len(data) == 2:
        return ShardedDataset(data[0], data[1])
    if isinstance(data, dict) and "x" in data:
        return ShardedDataset(data["x"], data.get("y"))
    if isinstance(data, (np.ndarray, dict, tuple, list)):
        return ShardedDataset(data)
    raise TypeError(f"cannot feed {type(data).__name__} to the estimator: "
                    "pass ndarrays, an (x, y) pair, an {'x', 'y'} dict, "
                    "XShards or a DataFrame")
